"""Training losses and classification metrics (port of the JAX package's
``train/losses.py``): mean softmax cross-entropy, as the reference's
``nn.CrossEntropyLoss`` and its per-point ``CrossEntropyLossSeg``, and
top-1 accuracies.

Under a mesh whose ``points`` axis is split, the per-point ones are this
rank's sums over its points, divided by the global point count and
summed over ``points`` (``parallel.collectives.reduce_points``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import collectives


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE: logits (B, C), labels (B,) int."""
    return F.cross_entropy(logits, labels.long())


def cross_entropy_seg(scores: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per-point mean softmax CE: scores (B, N, C), channel-last; seg
    (B, N) int."""
    P = collectives.axis_size("points")
    if P == 1:
        return F.cross_entropy(scores.reshape(-1, scores.shape[-1]),
                               seg.reshape(-1).long())
    total = F.cross_entropy(scores.reshape(-1, scores.shape[-1]),
                            seg.reshape(-1).long(), reduction="sum")
    return collectives.reduce_points(total / (seg.numel() * P))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy."""
    return (logits.argmax(-1) == labels).float().mean()


def seg_accuracy(scores: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per-point accuracy."""
    P = collectives.axis_size("points")
    right = (scores.argmax(-1) == seg).float()
    if P == 1:
        return right.mean()
    return collectives.reduce_points(right.sum() / (seg.numel() * P))
