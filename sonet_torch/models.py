"""Task models (port of the JAX package's ``models.py``): encoder + head.

The module tree keeps the JAX package's top-level split (``encoder`` /
``classifier``), so per-subnetwork weights map one to one.  Only the
classifier is ported so far; retrieval serves its scores as keys.
"""

from __future__ import annotations

import torch
from torch import nn

from .config import Config
from .device import resolve_device
from .nn.encoder import Encoder, EncoderOutput
from .nn.heads import ClassifierHead


class ClassifierModel(nn.Module):
    """Encoder + classification head."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, generator)
        self.classifier = ClassifierHead(cfg, generator)

    def forward(self, pc, sn, node, node_knn_I=None
                ) -> tuple[torch.Tensor, EncoderOutput]:
        enc = self.encoder(pc, sn, node, node_knn_I)
        return self.classifier(enc.feature), enc


_MODELS = {
    "classify": ClassifierModel,
    "retrieve": ClassifierModel,  # retrieval = classifier scores as keys
}


def build_model(cfg: Config, device: str | torch.device = "cuda",
                seed: int | None = None) -> nn.Module:
    """The model for ``cfg.task``, in eval mode on ``device``, with weights
    drawn from a ``torch.Generator`` seeded with ``seed`` (default
    ``cfg.seed``): He fan_in normal kernels, zero biases, unit BatchNorm.
    Raises when ``device`` is ``cuda`` and there is no card."""
    dev = resolve_device(device)
    if cfg.task not in _MODELS:
        raise NotImplementedError(
            f"task {cfg.task!r} is not ported yet (have {sorted(_MODELS)})")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return _MODELS[cfg.task](cfg, gen).to(dev).eval()
