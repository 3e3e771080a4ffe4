"""Host data layer of the port (counterpart of the JAX package's ``data``):
per-item seeding, augmentation, the threaded ``BatchLoader``, the
synthetic dataset and the ModelNet, SHREC16 and ShapeNetPart loaders.
The MNIST loader, the HDF5 reader, the mesh sampler and ``prep`` come
later (ROADMAP.md §1 item 11c)."""

from . import augmentation
from .modelnet import ModelNetDataset, ShrecDataset
from .pipeline import BatchLoader, collate
from .shapenet import ShapeNetPartDataset
from .synthetic import SyntheticDataset

__all__ = ["augmentation", "BatchLoader", "collate", "SyntheticDataset",
           "ModelNetDataset", "ShrecDataset", "ShapeNetPartDataset"]
