"""Point-cloud augmentation on the host (port of the JAX package's
``data/augmentation.py``; numpy only, the same draws in the same order).

Rebuild of the reference's data/augmentation.py:16-144 plus the inline
scale and shift augmentations of its loaders
(modelnet_shrec_loader.py:219-245).  Functions take and return numpy
``(N, 3)`` arrays and draw from a ``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def rotate_point_cloud_90(pc: np.ndarray, rng: np.random.Generator):
    """Random 0/90/180/270-degree rotation about y (augmentation.py:16-34)."""
    return pc @ _rot_y(rng.integers(0, 4) * np.pi / 2.0)


def rotate_point_cloud(pc: np.ndarray, rng: np.random.Generator):
    """Uniform rotation about y (augmentation.py:37-55)."""
    return pc @ _rot_y(rng.uniform() * 2 * np.pi)


def rotate_point_cloud_with_normal_som(pc, sn, som, rng):
    """Same uniform y-rotation applied to points, normals and SOM nodes
    (augmentation.py:58-79)."""
    R = _rot_y(rng.uniform() * 2 * np.pi)
    return pc @ R, sn @ R, som @ R


def _perturbation_matrix(rng, angle_sigma=0.06, angle_clip=0.18):
    a = np.clip(angle_sigma * rng.standard_normal(3), -angle_clip, angle_clip)
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(a[0]), -np.sin(a[0])],
                   [0, np.sin(a[0]), np.cos(a[0])]])
    Ry = np.array([[np.cos(a[1]), 0, np.sin(a[1])],
                   [0, 1, 0],
                   [-np.sin(a[1]), 0, np.cos(a[1])]])
    Rz = np.array([[np.cos(a[2]), -np.sin(a[2]), 0],
                   [np.sin(a[2]), np.cos(a[2]), 0],
                   [0, 0, 1]])
    return Rz @ Ry @ Rx


def rotate_perturbation_point_cloud(pc, rng, angle_sigma=0.06,
                                    angle_clip=0.18):
    """Small 3-axis rotation (augmentation.py:82-103)."""
    return pc @ _perturbation_matrix(rng, angle_sigma, angle_clip)


def rotate_perturbation_point_cloud_with_normal_som(pc, sn, som, rng,
                                                    angle_sigma=0.06,
                                                    angle_clip=0.18):
    """augmentation.py:106-130."""
    R = _perturbation_matrix(rng, angle_sigma, angle_clip)
    return pc @ R, sn @ R, som @ R


def jitter_point_cloud(pc, rng, sigma=0.01, clip=0.05):
    """Per-point gaussian jitter (augmentation.py:133-144).  SOM nodes use
    sigma=0.04, clip=0.1 at the call site (modelnet_shrec_loader.py:233)."""
    return pc + np.clip(sigma * rng.standard_normal(pc.shape), -clip, clip)


def train_augment(pc, sn, som_node, rng, *, rot_horizontal=False,
                  rot_perturbation=False, translation_perturbation=False,
                  scale_range=(0.8, 1.2), shift_range=0.1):
    """The full train-time augmentation stack of the loaders
    (modelnet_shrec_loader.py:219-245): optional rotations, jitter
    (pc/sn/som), random scale U(0.8,1.2), optional random shift."""
    if rot_horizontal:
        pc, sn, som_node = rotate_point_cloud_with_normal_som(
            pc, sn, som_node, rng)
    if rot_perturbation:
        pc, sn, som_node = rotate_perturbation_point_cloud_with_normal_som(
            pc, sn, som_node, rng)
    pc = jitter_point_cloud(pc, rng)
    sn = jitter_point_cloud(sn, rng)
    som_node = jitter_point_cloud(som_node, rng, sigma=0.04, clip=0.1)
    scale = rng.uniform(*scale_range)
    pc, sn, som_node = pc * scale, sn * scale, som_node * scale
    if translation_perturbation:
        shift = rng.uniform(-shift_range, shift_range, (1, pc.shape[1]))
        pc = pc + shift
        som_node = som_node + shift
    return (pc.astype(np.float32), sn.astype(np.float32),
            som_node.astype(np.float32))
