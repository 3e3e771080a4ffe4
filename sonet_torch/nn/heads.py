"""Task heads (port of the JAX package's ``nn/heads.py``): the classifier.
The part segmenter arrives with the segmentation slice."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import Config
from .encoder import layer_kw
from .layers import PointLayer


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout, as flax's ``nn.Dropout``: keep each entry with
    probability 1 - rate, drawn from ``generator`` (the default generator
    when None), and scale the kept entries by 1 / (1 - rate)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class ClassifierHead(nn.Module):
    """feature (B, F) -> logits (B, classes): FC 512 -> 256 -> classes,
    with dropout after fc1 and fc2 in training when ``cfg.dropout > 0.1``.
    ``fc3`` has no compute dtype, so it runs in float32, as in the JAX
    package."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.rate = cfg.dropout
        kw = dict(activation=cfg.activation, normalization=cfg.normalization,
                  **layer_kw(cfg))
        self.fc1 = PointLayer(cfg.feature_num, 512, generator, **kw)
        self.fc2 = PointLayer(512, 256, generator, **kw)
        self.fc3 = PointLayer(256, cfg.classes, generator, activation=None,
                              normalization=None)

    def forward(self, feature: torch.Tensor, epoch: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = self.training and self.rate > 0.1
        h = self.fc1(feature, epoch=epoch)
        if drop:
            h = dropout(h, self.rate, generator)
        h = self.fc2(h, epoch=epoch)
        if drop:
            h = dropout(h, self.rate, generator)
        return self.fc3(h)
