"""Training losses and classification metrics (port of the JAX package's
``train/losses.py``): mean softmax cross-entropy, as the reference's
``nn.CrossEntropyLoss``, and top-1 accuracy."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE: logits (B, C), labels (B,) int."""
    return F.cross_entropy(logits, labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy."""
    return (logits.argmax(-1) == labels).float().mean()
