"""HDF5 point-cloud loading helpers (port of the JAX package's
``data/h5.py``).

Parity with the vestigial h5 loaders in the reference
(modelnet_shrec_loader.py:21-25 ``load_h5`` and
shapenet_loader.py:22-27 ``load_h5_data_label_seg`` — the PointNet-style
``modelnet40_ply_hdf5_2048`` format).  h5py is optional: it is imported
only inside the functions, so importing the package does not need it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_h5(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (data (S, N, 3), label (S, 1))."""
    import h5py
    with h5py.File(path, "r") as f:
        return f["data"][:], f["label"][:]


def load_h5_data_label_seg(path: str):
    """Returns (data, label, seg) — 'pid' per-point part ids."""
    import h5py
    with h5py.File(path, "r") as f:
        return f["data"][:], f["label"][:], f["pid"][:]
