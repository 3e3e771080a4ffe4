"""Task heads (port of the JAX package's ``nn/heads.py``): the classifier
and the part segmenter, channel-last."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..ops.gather import gather_by_segment, permute_points
from ..parallel import collectives
from .encoder import EncoderOutput, layer_kw, spatial_dim
from .layers import PointLayer

NUM_SHAPE_CATEGORIES = 16  # ShapeNetPart object categories


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


class SegmenterHead(nn.Module):
    """Per-point part scores from the encoder's skip features.

    ``layer1`` is a ``ConcatDense`` over the un-concatenated parts, in
    this order (its kernel's rows): x_decentered, x_stack, centers,
    sn_stack (with surface normals), the category one-hot (B, 16),
    first_pn_out, the node-pooled 384 features gathered back to the
    points, the gathered kNN feature (som_k >= 2), the gathered final
    PointNet output, and the global feature (B, F); with normals and the
    kNN layer that is D + D + D + D + 16 + 384 + 384 + 512 + F + F
    channels.  Node maps are gathered back to the kN stacked points by
    the assignment index.  After three shared layers the points return to
    their original stacked order (sorted pipeline) and the k stacked
    copies are averaged back to N points; then layer4, dropout in
    training when ``cfg.dropout > 0.1``, and layer5 with no norm and no
    activation.  Scores are float32."""

    def __init__(self, cfg: Config, generator: torch.Generator):
        super().__init__()
        self.k = cfg.k
        self.rate = cfg.dropout
        self.surface_normal = cfg.surface_normal
        D = spatial_dim(cfg)
        widths = [D, D, D]
        if cfg.surface_normal:
            widths.append(D)
        widths += [NUM_SHAPE_CATEGORIES, 384, 384]
        if cfg.som_k >= 2:
            widths.append(512)
        widths += [cfg.feature_num, cfg.feature_num]
        # every layer runs on each rank's points under a mesh
        kw = dict(activation=cfg.activation, normalization=cfg.normalization,
                  sharded_points=True, **layer_kw(cfg))
        self.layer1 = PointLayer(widths, 1024, generator, **kw)
        self.layer2 = PointLayer(1024, 512, generator, **kw)
        self.layer3 = PointLayer(512, 256, generator, **kw)
        self.layer4 = PointLayer(256, 128, generator, **kw)
        self.layer5 = PointLayer(128, cfg.classes, generator, activation=None,
                                 normalization=None, sharded_points=True,
                                 **layer_kw(cfg))

    def forward(self, enc: EncoderOutput, label: torch.Tensor,
                epoch: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """enc: the encoder's output; label (B,) int shape category ->
        scores (B, N, classes)."""
        B, kN, _ = enc.x_stack.shape
        N = kN // self.k

        # under a mesh the node maps and the global feature are node-level
        # (the same on every points rank) and meet this rank's points here
        def to_points(node_feat):
            return gather_by_segment(collectives.to_points(node_feat),
                                     enc.min_idx, enc.onehot)

        label_onehot = F.one_hot(label.long(), NUM_SHAPE_CATEGORIES).to(
            enc.x_stack.dtype)                                   # (B, 16)
        parts = [enc.x_decentered, enc.x_stack, enc.centers]
        if self.surface_normal:
            parts.append(enc.sn_stack)
        parts += [label_onehot, enc.first_pn_out,
                  to_points(enc.first_pn_out_masked_max)]
        if enc.knn_feature is not None:
            parts.append(to_points(enc.knn_feature))
        parts += [to_points(enc.final_pn_out),
                  collectives.to_points(enc.feature)]

        h = self.layer1(*parts, epoch=epoch)
        h = self.layer2(h, epoch=epoch)
        h = self.layer3(h, epoch=epoch)

        # sorted pipeline: back to the original stacked order once, after
        # the permutation-equivariant shared layers, so that the k-copy
        # reshape below lines up
        if enc.inv_perm is not None:
            h = permute_points(h, enc.inv_perm, enc.perm)

        # average the k stacked copies (copy-major) back to N points (this
        # rank's N / P under a mesh: it stacked its own points)
        h = h.reshape(B, self.k, N, -1).mean(1)                  # (B, N, 256)

        h = self.layer4(h, epoch=epoch)
        if self.training and self.rate > 0.1:
            h = dropout(h, self.rate, generator)
        return self.layer5(h).float()
