#!/usr/bin/env python3
"""Where a ``Trainer`` epoch's time goes on the card, layer by layer, and
how the loader's threads and the way batches reach the card change it.

    python3 tools/torch_trainer_probe.py [--rounds 3]

Builds ``train.Trainer`` for ``config.modelnet40()`` on the synthetic
dataset (320 train clouds, nodes fitted on the card, point dropout from
0.8).  Each round times, for one epoch of 40 batches: the host loader
alone (``BatchLoader``: reads, augmentation, collation on its threads);
the train step alone, the captured step (``Trainer.train_graph``)
replayed on one batch already on the card; and the whole ``train_epoch``
in three set-ups, in the order A B C C B A so that a drift of the host's
speed falls on each alike:

* A: 4 loader threads (``BatchLoader``'s default), each batch pinned on
  the launching thread (``Trainer._device_batches``) and copied into the
  captured step's static buffers on the compute stream;
* B: 1 loader thread, copied the same way;
* C: 4 loader threads, each batch copied to the card on a thread of its
  own on a side stream, two batches ahead, the step's stream waiting on
  an event; the captured step then copies it card to card into its
  buffers.

Each time is the host clock around work that ends in
``torch.cuda.synchronize()``, per batch.  Prints the card's name and
power limit first, and each set-up's range and median over the rounds
last.
"""

from __future__ import annotations

import argparse
import os
import queue
import statistics
import subprocess
import sys
import threading
import time


def copy_thread_batches(trainer, loader, depth: int = 2):
    """Set-up C: ``(batch on the card, valid)`` for ``loader``, copied on
    a background thread on a stream of its own ``depth`` batches ahead; the
    consumer's stream waits for each batch's event, and each tensor is
    marked as used there so that its memory is not reused too early."""
    import torch
    stream = torch.cuda.Stream(trainer.device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for batch in loader:
                valid = int(batch.pop("valid", trainer.cfg.batch_size))
                pinned = trainer._pinned_batch(batch)
                with torch.cuda.stream(stream):
                    db = {k: v.to(trainer.device, non_blocking=True)
                          for k, v in pinned.items()}
                    event = torch.cuda.Event()
                    event.record(stream)
                if not put((db, valid, event)):
                    return
            put(end)
        except Exception as e:  # noqa: BLE001 -- raised by the consumer
            put((e,))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if len(item) == 1:
                raise item[0]
            db, valid, event = item
            current = torch.cuda.current_stream(trainer.device)
            current.wait_event(event)
            for v in db.values():
                v.record_stream(current)
            yield db, valid
    finally:
        stop.set()
        t.join(timeout=10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("torch_trainer_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from sonet_torch import config
    from sonet_torch.train import Trainer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as runs:
        cfg = config.modelnet40().replace(
            dataset="synthetic", random_pc_dropout_lower_limit=0.8,
            checkpoints_dir=runs, name="probe")
        t = Trainer(cfg, quiet=True, resume=False, device="cuda")
        n = t.steps_per_epoch
        plain = t._device_batches
        batch = {k: v.to(t.device) for k, v in
                 next(iter(plain(t.train_loader)))[0].items()}

        def setup(threads, copies):
            def run():
                t.train_loader.num_threads = threads
                t._device_batches = copies
                t.train_epoch(0)
            return run

        def loader():
            t.train_loader.num_threads = 4
            for _ in t.train_loader:
                pass

        def steps():
            for _ in range(n):
                t.train_graph(**batch)

        setups = {
            "A: 4 loader threads": setup(4, plain),
            "B: 1 loader thread": setup(1, plain),
            "C: 4 loader threads, copy thread": setup(
                4, lambda loader: copy_thread_batches(t, loader)),
        }
        order = list(setups) + list(setups)[::-1]
        for fn in setups.values():                   # warm up every path
            fn()
        readings = {name: [] for name in setups}
        for r in range(args.rounds):
            what = [("loader alone, 4 threads", loader),
                    ("step alone", steps)]
            what += [(name, setups[name]) for name in order]
            for name, fn in what:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / n
                readings.get(name, []).append(ms)
                print(f"round {r}: {name}: {ms:.4f} ms a batch "
                      f"({cfg.batch_size / ms * 1e3:.1f} clouds/s)",
                      flush=True)
        for name, ms in readings.items():
            print(f"{name}: train_epoch {min(ms):.4f}-{max(ms):.4f} ms a "
                  f"step over {len(ms)} readings, median "
                  f"{statistics.median(ms):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
