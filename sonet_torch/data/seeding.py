"""Deterministic per-item random generators for augmentation (port of the
JAX package's ``data/seeding.py``; numpy only).

Draws are a pure function of (seed, mode, epoch, index): the same across
runs, across loader threads and across the two packages.  Datasets expose
``set_epoch`` so that the ``BatchLoader`` re-seeds each pass and the
augmentation still changes from epoch to epoch.
"""

from __future__ import annotations

import numpy as np

_MODE_IDS = {"train": 0, "test": 1, "val": 2}


def mode_id(mode: str) -> int:
    return _MODE_IDS.get(mode, 3)


class EpochSeeded:
    """Mixin: deterministic per-item generators keyed on epoch."""

    def _init_seeding(self, seed: int, mode: str) -> None:
        self._seed = int(seed)
        self._mode_id = mode_id(mode)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def item_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            (self._seed, self._mode_id, self._epoch, int(idx)))
