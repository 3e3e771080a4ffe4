"""Task models (port of the JAX package's ``models.py``): encoder + head.

The module tree keeps the JAX package's top-level split (``encoder`` /
``classifier`` / ``segmenter`` / ``decoder``), so per-subnetwork
checkpoints, the encoder-only transfer and per-subnetwork learning rates
map one to one.  Retrieval serves the classifier's scores as keys.  Train
or eval follows
``nn.Module.training``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import Config
from .device import resolve_device
from .nn.decoder import Decoder, DecoderOutput
from .nn.encoder import Encoder, EncoderOutput
from .nn.heads import ClassifierHead, SegmenterHead


class ClassifierModel(nn.Module):
    """Encoder + classification head."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, generator)
        self.classifier = ClassifierHead(cfg, generator)

    def forward(self, pc, sn, node, node_knn_I=None, *,
                epoch: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, EncoderOutput]:
        """``epoch`` drives the BatchNorm momentum decay and ``generator``
        the dropout masks; both are read in training only."""
        enc = self.encoder(pc, sn, node, node_knn_I, epoch=epoch)
        return self.classifier(enc.feature, epoch, generator), enc


class SegmenterModel(nn.Module):
    """Encoder + per-point part segmenter."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, generator)
        self.segmenter = SegmenterHead(cfg, generator)

    def forward(self, pc, sn, node, label, node_knn_I=None, *,
                epoch: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, EncoderOutput]:
        """``label`` (B,) is the shape category; scores are (B, N, classes).
        ``epoch`` and ``generator`` as in ``ClassifierModel``."""
        enc = self.encoder(pc, sn, node, node_knn_I, epoch=epoch)
        return self.segmenter(enc, label, epoch, generator), enc


class AutoencoderModel(nn.Module):
    """Encoder + two-branch point decoder."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, generator)
        self.decoder = Decoder(cfg, generator)

    def forward(self, pc, sn, node, node_knn_I=None, *,
                epoch: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> tuple[DecoderOutput, EncoderOutput]:
        """The reconstruction is ``dec.pc`` (B, output points, 3), float32.
        ``epoch`` as in ``ClassifierModel``; the model draws no random
        numbers, so ``generator`` is not read."""
        enc = self.encoder(pc, sn, node, node_knn_I, epoch=epoch)
        return self.decoder(enc.feature, epoch), enc


_MODELS = {
    "classify": ClassifierModel,
    "retrieve": ClassifierModel,  # retrieval = classifier scores as keys
    "segment": SegmenterModel,
    "autoencode": AutoencoderModel,
}


def build_model(cfg: Config, device: str | torch.device = "cuda",
                seed: int | None = None) -> nn.Module:
    """The model for ``cfg.task``, in eval mode on ``device``, with weights
    drawn from a ``torch.Generator`` seeded with ``seed`` (default
    ``cfg.seed``): He fan_in normal kernels, zero biases, unit BatchNorm
    (the decoder: fan_out kernels and 0.001 biases in its convolutions,
    U(-1, 1) biases in the layers that emit points).
    Raises when ``device`` is ``cuda`` and there is no card.  The train
    entry point (``train.init_state``) switches it to train mode."""
    dev = resolve_device(device)
    if cfg.task not in _MODELS:
        raise NotImplementedError(
            f"unknown task {cfg.task!r} (have {sorted(_MODELS)})")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return _MODELS[cfg.task](cfg, gen).to(dev).eval()
