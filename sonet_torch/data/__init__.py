"""Host data layer of the port (counterpart of the JAX package's ``data``):
per-item seeding, augmentation, the threaded ``BatchLoader``, the
synthetic dataset, the ModelNet, SHREC16, ShapeNetPart and MNIST loaders,
the HDF5 readers (``h5``; h5py is imported only when they are called),
the mesh sampler (``sampler``) and the ``prep`` command."""

from . import augmentation
from .mnist import MNISTPointCloudDataset
from .modelnet import ModelNetDataset, ShrecDataset
from .pipeline import BatchLoader, collate
from .shapenet import ShapeNetPartDataset
from .synthetic import SyntheticDataset

__all__ = ["augmentation", "BatchLoader", "collate", "SyntheticDataset",
           "ModelNetDataset", "ShrecDataset", "ShapeNetPartDataset",
           "MNISTPointCloudDataset"]
