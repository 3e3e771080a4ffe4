"""Traffic generators: each reads a traffic file's parameters
(``benchmark/traffic/<name>.json``) and the run's seed.

* ``EpochRows``: a training run's batches, as index rows into the split
  (shuffled epochs cut to whole batches), handed out in parts;
* ``arrivals``: an open loop's schedule, requests due at fixed offsets
  and the request body each sends.

A seed changes the order of the work, never its amount: every seed gets
the same epochs of the same length, and the same set of gaps between
arrivals in another order.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from ..data import sub_seed
from ..harness import load_json

DIR = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return load_json(DIR / f"{name}.json")


def epoch_table(items: int, batch: int, seed: int, epoch: int) -> np.ndarray:
    """(items // batch, batch) int64: epoch ``epoch``'s shuffle of the
    split, cut to whole batches."""
    rng = np.random.default_rng(sub_seed(seed, f"epoch{epoch}"))
    order = rng.permutation(items)[: (items // batch) * batch]
    return order.reshape(-1, batch).astype(np.int64)


class EpochRows:
    """The batches of epoch after epoch, handed out in order."""

    def __init__(self, items: int, batch: int, seed: int):
        self.items, self.batch, self.seed = items, batch, seed
        self.epoch, self.pos = 0, 0
        self.table = epoch_table(items, batch, seed, 0)
        if len(self.table) == 0:
            raise ValueError(f"a split of {items} items has no batch of "
                             f"{batch}")

    @property
    def steps_per_epoch(self) -> int:
        return len(self.table)

    def take(self, n: int) -> np.ndarray:
        """The next up to ``n`` rows (S, B), never across an epoch's end."""
        if self.pos == len(self.table):
            self.epoch += 1
            self.pos = 0
            self.table = epoch_table(self.items, self.batch, self.seed,
                                     self.epoch)
        rows = self.table[self.pos:self.pos + n]
        self.pos += len(rows)
        return rows


def arrivals(rate: float, seconds: float, bodies: int, seed: int):
    """(due offsets in s (n,), body index (n,)) of n = round(rate *
    seconds) requests: the gaps before each request, from the start, are
    the n exponential quantiles of mean 1 / rate (a Poisson process's) in
    an order drawn from the seed, and the bodies cycle through ``bodies``
    in an order drawn from it."""
    n = max(int(round(rate * seconds)), 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(sub_seed(seed, "arrivals"))
    due = np.cumsum(rng.permutation(gaps))
    which = rng.permutation(np.arange(n) % bodies)
    return due, which.astype(np.int64)


def lateness_growth(due: np.ndarray, sent: np.ndarray) -> float:
    """The generator's lateness in the last third of a schedule minus that
    in the first third (medians, s): near 0 while the load is kept up."""
    n = len(due)
    third = max(n // 3, 1)
    late = sent - due
    return float(np.median(late[-third:]) - np.median(late[:third]))


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by nearest rank; +inf counts as a value
    above every finite one."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if len(v) == 0:
        return math.nan
    rank = max(int(math.ceil(q / 100.0 * len(v))), 1)
    return float(v[rank - 1])
