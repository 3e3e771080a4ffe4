"""Task heads (port of the JAX package's ``nn/heads.py``): the classifier.
The part segmenter arrives with the segmentation slice."""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config
from .encoder import compute_dtype
from .layers import PointLayer


class ClassifierHead(nn.Module):
    """feature (B, F) -> logits (B, classes): FC 512 -> 256 -> classes.
    Dropout sits between the layers in training; in eval it is the
    identity, and only eval is ported so far.  ``fc3`` has no compute
    dtype, so it runs in float32, as in the JAX package."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        kw = dict(activation=cfg.activation, normalization=cfg.normalization,
                  compute_dtype=compute_dtype(cfg))
        self.fc1 = PointLayer(cfg.feature_num, 512, generator, **kw)
        self.fc2 = PointLayer(512, 256, generator, **kw)
        self.fc3 = PointLayer(256, cfg.classes, generator, activation=None,
                              normalization=None)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        return self.fc3(self.fc2(self.fc1(feature)))
