"""Host input pipeline: the dataset protocol and the threaded batch loader
(port of the JAX package's ``data/pipeline.py``; numpy and stdlib only).

Items are dicts of numpy arrays; the loader shuffles, collates
fixed-shape batches and prefetches them on a thread pool, so file reads
and augmentation overlap the card's work.  Node kNN happens on the
device inside the encoder, so the host does file reads and augmentation
only.

Reproducibility: a dataset that has ``set_epoch(epoch)`` is re-seeded by
the loader every pass, so its augmentation draws are a function of
(seed, epoch, index) alone, whatever the threads' timing, and a loader
gives the same batches in the same order as the JAX package's for the
same seed.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Protocol, Sequence

import numpy as np


class Dataset(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]: ...


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = items[0].keys()
    return {k: np.stack([it[k] for it in items]) for k in keys
            if items[0][k] is not None}


class BatchLoader:
    """Shuffling, drop-last batch iterator with bounded threaded prefetch.

    At most ``prefetch + num_threads`` batches are in flight at any time
    (a sliding window of futures), so memory stays bounded and an
    abandoned iterator shuts the producer down promptly.

    ``pad_last=True`` repeats items to fill the final batch and reports
    ``batch["valid"]`` counts so eval loops can weight correctly (the
    reference weights test metrics by true batch size,
    modelnet/train.py:78-90).
    """

    def __init__(self, dataset: Dataset, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 pad_last: bool = False, num_threads: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last and not pad_last
        self.pad_last = pad_last
        self.rng = np.random.default_rng(seed)
        self.num_threads = num_threads
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def skip_epoch(self) -> None:
        """Advance the epoch and the shuffle as one pass would, loading
        nothing."""
        self._epoch += 1
        self._index_batches()

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        bs = self.batch_size
        nfull = len(idx) // bs
        batches = [(idx[i * bs:(i + 1) * bs], bs) for i in range(nfull)]
        rem = idx[nfull * bs:]
        if len(rem) and not self.drop_last:
            valid = len(rem)
            if self.pad_last:
                fill = idx[: bs - valid]
                rem = np.concatenate([rem, fill])
            batches.append((rem, valid))
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # per-epoch deterministic re-seed for datasets that support it
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1

        batches = self._index_batches()
        if self.num_threads <= 1:
            for b, valid in batches:
                yield self._make(b, valid)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        SENTINEL = object()

        def put_blocking(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce():
            # sliding window: at most (prefetch + num_threads) batches in
            # flight; a stopped consumer is noticed within the timeout.
            # A worker exception is forwarded to the consumer (wrapped in
            # a 1-tuple so batch dicts are never confused with errors) —
            # NOT swallowed into a silently-short epoch.
            with ThreadPoolExecutor(self.num_threads) as ex:
                window = []
                it = iter(batches)
                try:
                    while not stop.is_set():
                        while len(window) < self.num_threads + self.prefetch:
                            nxt = next(it, None)
                            if nxt is None:
                                break
                            window.append(ex.submit(self._make, *nxt))
                        if not window:
                            break
                        try:
                            result = window.pop(0).result()
                        except Exception as e:  # noqa: BLE001
                            put_blocking((e,))
                            return
                        put_blocking(result)
                finally:
                    for f in window:
                        f.cancel()
                    try:
                        q.put_nowait(SENTINEL)
                    except queue.Full:
                        pass

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        produced = 0
        try:
            while produced < len(batches):
                item = q.get()
                if item is SENTINEL:
                    break
                if type(item) is tuple:
                    raise item[0]
                produced += 1
                yield item
        finally:
            stop.set()
            # drain so a blocked producer can observe `stop`
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def _make(self, indices, valid) -> Dict[str, np.ndarray]:
        # a dataset may assemble a whole batch itself (the native C++
        # loader, data/native_loader.py, runs its threads inside the call)
        mk = getattr(self.dataset, "make_batch", None)
        if mk is not None:
            return mk(indices, valid)
        batch = collate([self.dataset[int(i)] for i in indices])
        batch["valid"] = np.asarray(valid, np.int32)
        return batch
